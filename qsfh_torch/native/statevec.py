"""Float64 rot programs on the card: the flagship's polish engine.

Counterpart of ``qsfh_tpu/native/statevec.py``, which binds the host C++
engine ``statevec64.cpp`` for the float64 endgame of the 3x3 ADAPT ansatz
(``benchmarks/demo_3x3/polish_fast.py``: scipy L-BFGS-B on
``value_and_grad``, then Newton-CG on central-difference Hessian-vector
products).  The semantics are the same: a rot segment's consecutive terms
grouped by (flip mask, parameter, parity of x & z), each group one closed
form exp(-i theta M), H psi from the observable's scan terms, and the fused
adjoint sweep.  Here the group arrays and the state live on the card, in
complex128, and every pass is a CUDA kernel (``engine.kernels``).  The
forward pass and the adjoint sweep take one of two routes, chosen from the
layout when the program is built and shown as ``prog.route``:
``"resident"`` (``rot64_resident`` / ``adjoint64_resident``: the groups cut
into tile runs, ``streaming.Group64Runs``, one cooperative launch a pass)
wherever every group fits a tile of ``RESIDENT64_TILE_BITS`` (the low
``RESIDENT64_TILE_LOW_BITS`` flat bits and the run's flip bits above them),
else ``"groups"`` (``rot64_groups`` / ``adjoint64_groups``: one launch a
group).  H psi takes one of two kernels, shown as ``prog.h_route``:
``"tiles"`` (``happly64_tiles``: H's terms in the application tiles of
``streaming.apply64_layout``, one state pass and launch a tile, E and N
folded in the last) where ``kernels.f64_tile_layout`` takes H's layout,
else ``"terms"`` (``happly64``: one amplitude a thread over
H's terms).  With ``device="cpu"`` the wrappers take their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import streaming
from ..engine.compiled import CompiledCircuit, givens_network_static_ops
from ..engine.kernels import KERNELS, Groups64, f64_tile_layout
from ..engine.state import resolve_device
from ..utils.profiling import span

ROUTES = ("resident", "groups")


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, np.float64)


class Rot64Program:
    """A lowered rot segment and an observable, prepared for float64
    evaluations on one device.

    Build it from a rot segment's ``data`` (``engine.compiled.Segment``; numpy
    or torch arrays) and an observable's scan terms
    (``Observable._scan_terms()``), or from an ADAPT driver with
    :meth:`from_adapt`.  ``device``: the card by default (raising where
    there is none); ``"cpu"`` runs the plain versions.  ``impl``: the
    wrappers (``engine.kernels.KERNELS``, the default) or ``PLAIN`` (the
    plain versions on any device, a reference on the card).  ``theta`` and
    ``psi0`` may be numpy arrays or tensors; states come back as complex128
    tensors on the program's device.  ``route``: None chooses from the
    layout (``"resident"`` where every group fits a tile of ``tile_bits``
    bits, the low ``low_bits`` flat, and n >= tile_bits; else
    ``"groups"``); ``"groups"`` forces the per-group kernels, and
    ``"resident"`` raises where the layout does not allow it.  H psi's
    kernel, ``h_route``, comes from H's layout: ``"tiles"`` where
    ``kernels.f64_tile_layout`` takes H's tiles
    (``streaming.apply64_layout``), else ``"terms"``; ``h_args``
    holds the H arrays that route reads (:meth:`h_arrays`).
    """

    def __init__(self, n, seg_data, h_terms, n_params, device=None, impl=None, route=None,
                 tile_bits=None, low_bits=None):
        self.device = resolve_device(device)
        self.impl = impl or KERNELS
        self.n = int(n)
        self.n_params = int(n_params)
        (self.gx, self.gpidx, self.gflip, self.goff, self.zsub,
         self.wsub) = streaming.group_terms(*(np.asarray(seg_data[k]) for k in
                                     ("xb", "zb", "scale", "pidx", "phre", "phim")))
        self.G = len(self.gx)
        xs, zs, cre, cim = (np.asarray(a) for a in h_terms)
        self.hx = np.ascontiguousarray(xs, np.uint32)
        self.hz = np.ascontiguousarray(zs, np.uint32)
        self.hcre = np.ascontiguousarray(cre, np.float64)
        self.hcim = np.ascontiguousarray(cim, np.float64)

        dev = self.device
        rows = np.flatnonzero(self.gpidx >= 0)
        by_param = rows[np.argsort(self.gpidx[rows], kind="stable")]
        counts = np.bincount(self.gpidx[rows], minlength=self.n_params)
        if counts.shape[0] != self.n_params:
            raise ValueError(f"a group's parameter index exceeds n_params = {self.n_params}")

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int64).astype(np.int32), device=dev)

        self.groups = Groups64(
            gx=i32(self.gx), goff=i32(self.goff), gflip=i32(self.gflip),
            gpidx=i32(np.where(self.gpidx < 0, self.n_params, self.gpidx)),
            zsub=i32(self.zsub), wsub=torch.as_tensor(self.wsub, device=dev),
            param_off=i32(np.concatenate([[0], np.cumsum(counts)])), param_groups=i32(by_param),
        )
        # H's application tiles where the route takes them, and the H arrays
        # on the device that the route reads
        self.h_tiles = f64_tile_layout(
            "happly64_tiles", self.n, lambda: streaming.apply64_layout(self.hx, self.hz, self.n))
        self.h_route = "terms" if self.h_tiles is None else "tiles"
        self.h_args = self.h_arrays(self.h_route)
        # the angles the kernels read, [theta | 1.0]: the static groups
        # (parameter index -1) take the last entry
        self.theta_ext = torch.ones(self.n_params + 1, dtype=torch.float64, device=dev)

        k = streaming.RESIDENT64_TILE_BITS if tile_bits is None else int(tile_bits)
        c = streaming.RESIDENT64_TILE_LOW_BITS if low_bits is None else int(low_bits)
        if not (streaming.RESIDENT64_MIN_BITS <= k <= streaming.RESIDENT64_MAX_BITS
                and 0 <= c <= k):
            raise ValueError(f"tiles of {k} bits, {c} low: the resident kernels take "
                             f"{streaming.RESIDENT64_MIN_BITS}-{streaming.RESIDENT64_MAX_BITS}")
        fits = streaming.group_runs_fit(self.gx, self.n, k, c)
        if route not in (None, *ROUTES):
            raise ValueError(f"route {route!r}: expected one of {ROUTES}")
        if route == "resident" and not fits:
            raise ValueError(f"a group fits no {k}-bit tile of {self.n} qubits")
        self.route = route or ("resident" if fits else "groups")
        self.runs = (streaming.Group64Runs(self.gx, self.goff, self.zsub, self.n, k, c)
                     if self.route == "resident" else None)

    @classmethod
    def from_adapt(cls, vqe, indices=None, impl=None, **kwargs):
        """Build from an ADAPT driver on its device: the selected pool
        rotations and the Givens network as one rot segment, and H."""
        if indices is None:
            indices = tuple(vqe.selected_indices)
        p = vqe.problem
        ops = [("rot", tuple(vqe.pool_rot[i]), slot) for slot, i in enumerate(indices)]
        net_ops, _ = givens_network_static_ops(vqe.n_qubits, p.diagonal, p.decomposition)
        cc = CompiledCircuit(ops + net_ops, vqe.n_qubits)
        if len(cc.segments) != 1 or cc.segments[0].kind != "rot":
            raise ValueError("the ansatz did not lower to one rot segment")
        return cls(vqe.n_qubits, cc.segments[0].data, p.observables["H"]._scan_terms(),
                   len(indices), device=vqe.device, impl=impl, **kwargs)

    def _angles(self, theta) -> torch.Tensor:
        """theta into ``theta_ext`` (on the device); returns it."""
        if not isinstance(theta, torch.Tensor):
            theta = torch.from_numpy(_host(theta))
        if theta.shape != (self.n_params,):
            raise ValueError(f"expected ({self.n_params},) angles, got {tuple(theta.shape)}")
        self.theta_ext[:-1].copy_(theta)
        return self.theta_ext

    def _state(self, psi) -> torch.Tensor:
        """A complex128 copy of psi on the device."""
        psi = torch.as_tensor(psi)
        if psi.shape != (1 << self.n,):
            raise ValueError(f"expected a ({1 << self.n},) state, got {tuple(psi.shape)}")
        out = torch.empty(1 << self.n, dtype=torch.complex128, device=self.device)
        return out.copy_(psi)

    def apply(self, theta, psi0) -> torch.Tensor:
        """The full program on psi0 (complex128)."""
        psi, th = self._state(psi0), self._angles(theta)
        if self.route == "resident":
            return self.impl.rot64_resident(psi, self.groups, th, self.runs)
        return self.impl.rot64_groups(psi, self.groups, th)

    def _adjoint(self, psi, lam) -> torch.Tensor:
        """The reverse sweep on the route (in place on psi and lam)."""
        if self.route == "resident":
            return self.impl.adjoint64_resident(psi, lam, self.groups, self.theta_ext, self.runs)
        return self.impl.adjoint64_groups(psi, lam, self.groups, self.theta_ext)

    def h_arrays(self, route: str):
        """H's terms (xs, zs, cre, cim) on the device as ``route``'s kernel
        reads them: ``"tiles"`` in their own order (the layout reads the
        coefficients by input index), ``"terms"`` sorted by flip mask,
        stable (``happly64`` shares one gather along a run of equal masks)."""
        order = (np.arange(self.hx.size) if route == "tiles"
                 else np.argsort(self.hx, kind="stable"))
        dev = self.device
        return (torch.as_tensor(self.hx[order].astype(np.int32), device=dev),
                torch.as_tensor(self.hz[order].astype(np.int32), device=dev),
                torch.as_tensor(self.hcre[order], device=dev),
                torch.as_tensor(self.hcim[order], device=dev))

    def _happly(self, psi, scale=1.0):
        """(scale H psi, [E, 0, N, 0]) on the H route."""
        if self.h_route == "tiles":
            return self.impl.happly64_tiles(psi, *self.h_args, self.h_tiles, scale)
        return self.impl.happly64(psi, *self.h_args, scale)

    def h_launches(self) -> dict:
        """The kernel launches of one H psi on the H route (an evaluation
        makes one H psi, an HVP two evaluations)."""
        if self.h_route == "terms":
            return {"happly64": 1}
        spill = {"happly64": 1} if self.h_tiles.spill_index.size else {}
        return {"happly64_tiles": self.h_tiles.n_tiles, **spill}

    def h_apply(self, psi) -> torch.Tensor:
        """H |psi> (complex128)."""
        return self._happly(self._state(psi))[0]

    def energy(self, theta, psi0) -> float:
        psi = self.apply(theta, psi0)
        return float(self._happly(psi)[1][0])

    def value_and_grad(self, theta, psi0):
        """(E, dE/dtheta) as (float, float64 numpy array), through the fused
        adjoint sweep: lambda = 2 H psi, E = Re <psi|H psi> read before the
        doubling.  One host read; the call is the span
        ``f64.value_and_grad`` (``utils/profiling.py``)."""
        with span("f64.value_and_grad"):
            psi = self.apply(theta, psi0)
            lam, stats = self._happly(psi, 2.0)
            grad = self._adjoint(psi, lam)
            out = torch.cat([stats[:1], grad]).cpu().numpy()
        return float(out[0]), out[1:]

    def hvp(self, theta, psi0, v, eps=1e-6) -> np.ndarray:
        """Central-difference Hessian-vector product from two adjoint evals."""
        v = _host(v)
        vn = float(np.linalg.norm(v))
        if vn == 0.0:
            return np.zeros_like(v)
        h = eps / vn
        theta = _host(theta)
        _, gp = self.value_and_grad(theta + h * v, psi0)
        _, gm = self.value_and_grad(theta - h * v, psi0)
        return (gp - gm) / (2.0 * h)
