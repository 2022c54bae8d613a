"""Circuits lowered to homogeneous segments.

Counterpart of ``qsfh_tpu/engine/compiled.py`` for ``rot``, ``u4``,
``diag`` and ``rzlayer`` segments.  Consecutive ("rot", rot_terms,
param_idx) ops become one segment of per-term arrays (flip mask, phase
mask, scale, parameter index, string phase), rotated forward and backward,
and swept in reverse by the adjoint for gradients.  Static-angle terms
carry parameter index -1, which selects an appended constant 1.0.  A
("diag", weights, k) op (exp(-i theta_k D), D a real 2^n vector: the HVA
Coulomb layer) and a ("fixed", "rzlayer" | "rz", angles) op (a layer of
static RZ gates) are one elementwise phase pass each, as
``qsfh_tpu/engine/compiled.py:232-248, 580-588`` computes them outside
Pallas; the inverse negates the angle.  Consecutive ("fixed", "u4" |
"se" | "x", ...) ops (programs over ``grad.adjoint.givens_network_ops``:
the Givens network as 4x4 gates) become one ``u4`` segment grouped as
``qsfh_tpu/engine/compiled.py:180-235`` groups them (qubits ordered with
the gate's axes swapped to match, ``se`` as its 4x4, ``x`` lifted onto its
neighbour); each gate is one ``einsum`` over the state's (..., 2, ..., 2,
...) view, where the JAX package (plain jnp in a scan, no Pallas) sums
four flipped copies; the inverse is each gate's conjugate transpose in
reverse order.  The HEA lowers to a rot segment (``algos/hea.py``).

A segment is walked as the order-preserving tile runs of
``streaming.TileLayout``: runs of terms whose flip masks all lie in one
tile of chosen bits; a term that fits no tile goes to the per-term
kernels (``pauli_rotation`` / ``adjoint_rotation``).  Up to
``streaming.CHAIN_MAX_QUBITS`` the state sits in L2 and a span of runs is
one ``rotation_resident`` / ``adjoint_resident`` launch, where the JAX
package runs ``pauli_chain_pallas`` / ``adjoint_chain_pallas`` on a
VMEM-resident state; past it each run is one ``rotation_tile_runs`` /
``adjoint_tile_runs`` launch, the JAX package's ``rotation_stream_pallas``
/ ``adjoint_stream_pallas`` route (``qsfh_tpu/engine/compiled.py:505-534,
645-667``) without its block-crossing terms.  A state smaller than the
smallest tile (``kernels.TILE_MIN_BITS``) takes the per-term kernels.

The TPU workarounds of the JAX module are not carried over: per-term
angles are the plain gather ``thetas_ext[pidx]`` (no one-hot matmul),
gradients are summed per parameter by ``state.IndexFold`` (the same bits
on every call, where ``index_add_`` adds with atomics on the card), and
terms are not reordered.  The JAX module's grouping of consecutive
commuting same-flip strings into one closed-form rotation
(``_group_rot_terms``) lives inside the tile kernels: each layout's
``streaming.fused_groups``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import streaming
from .gates import static_rz_layer_phases
from .kernels import KERNELS, TILE_MIN_BITS
from .state import IndexFold, qmask_to_bmask, real_dtype


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
    them per (device, real dtype) with int64 masks, and ``tiles`` the tile
    layout of each direction.
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
                # the adjoint's per-term contributions come in reversed order
                "fold": IndexFold(pidx[::-1], n_params, device),
            }
        return self._cache[key]

    def tiles(self, direction: int, n: int, k: int, c: int) -> streaming.TileLayout:
        """The tile layout of the terms in application order (reversed for
        direction -1, the inverse and the adjoint sweep), its fused groups
        (``streaming.fused_groups``) from the parameter indices and string
        phases."""
        key = ("tiles", direction, n, k, c)
        if key not in self._cache:
            d = self.data
            self._cache[key] = streaming.TileLayout(
                *(d[name][::direction] for name in ("xb", "zb")), n, k, c,
                *(d[name][::direction] for name in ("pidx", "phre", "phim")))
        return self._cache[key]


def _rot_segment(buf, n: int) -> Segment:
    xs, zs, scales, pidx, phre, phim = [], [], [], [], [], []
    for (x, z, scale, k) in buf:
        xs.append(qmask_to_bmask(x, n))
        zs.append(qmask_to_bmask(z, n))
        scales.append(scale)
        pidx.append(k)
        ph = (-1j) ** (bin(x & z).count("1") % 4)
        phre.append(ph.real)
        phim.append(ph.imag)
    return Segment(
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


def _u4_segment(buf, n: int) -> Segment:
    """(4x4 gate, qa, qb) entries as one ``u4`` segment: flat masks of the
    lower and higher qubit and the gates as (T, 4, 4, 2) real planes, each
    gate's axes swapped where qa > qb (the JAX package's layout)."""
    fa, fb, mats = [], [], []
    for (M, qa, qb) in buf:
        Ma = np.asarray(M, dtype=np.complex128).reshape(4, 4)
        if qa > qb:
            Ma = Ma.reshape(2, 2, 2, 2).transpose(1, 0, 3, 2).reshape(4, 4)
            qa, qb = qb, qa
        fa.append(1 << (n - 1 - qa))
        fb.append(1 << (n - 1 - qb))
        mats.append(np.stack([Ma.real, Ma.imag], axis=-1))
    return Segment("u4", dict(fa=np.asarray(fa, np.uint32), fb=np.asarray(fb, np.uint32),
                              U=np.asarray(mats, np.float64)))


_PAULI_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)


def _u4_entry(tag: str, payload):
    """A ``u4``, ``se`` or ``x`` fixed op as (4x4 gate, qa, qb)."""
    if tag == "u4":
        flat, i, j = payload
        return np.array(flat).reshape(4, 4), i, j
    if tag == "se":
        ang, i, j = payload
        c, s = np.cos(ang / 2), np.sin(ang / 2)
        M = np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
                     dtype=np.complex128)
        return M, i, j
    # x: lifted to a u4 on (q, partner) to stay in the segment
    q = payload[0]
    partner = q - 1 if q > 0 else q + 1
    M = np.kron(np.eye(2), _PAULI_X) if partner < q else np.kron(_PAULI_X, np.eye(2))
    return M, min(partner, q), max(partner, q)


def lower_program(ops: Sequence[tuple], n: int) -> List[Segment]:
    """Group a gate program into homogeneous segments: runs of ``rot`` ops
    into one ``rot`` segment each, runs of ``u4`` / ``se`` / ``x`` fixed ops
    into one ``u4`` segment each, every ``diag`` op and every ``rzlayer``
    or ``rz`` fixed op into a phase segment of its own."""
    segments: List[Segment] = []
    rot_buf: List[tuple] = []
    u4_buf: List[tuple] = []

    def flush_rot():
        if rot_buf:
            segments.append(_rot_segment(rot_buf, n))
            rot_buf.clear()

    def flush_u4():
        if u4_buf:
            segments.append(_u4_segment(u4_buf, n))
            u4_buf.clear()

    for op in ops:
        if op[0] == "rot":
            flush_u4()
            _, rot_terms, k = op
            rot_buf.extend((x, z, scale, k) for (x, z, scale) in rot_terms)
        elif op[0] == "diag":
            flush_rot()
            flush_u4()
            _, weights, k = op
            segments.append(Segment("diag", (weights, int(k))))
        elif op[0] == "fixed" and op[1] in ("u4", "se", "x"):
            flush_rot()
            u4_buf.append(_u4_entry(op[1], op[2]))
        elif op[0] == "fixed" and op[1] in ("rzlayer", "rz"):
            flush_rot()
            flush_u4()
            if op[1] == "rz":
                phi, q = op[2]
                angles = [0.0] * n
                angles[q] = float(phi)
            else:
                angles = [float(a) for a in op[2]]
            segments.append(Segment("rzlayer", tuple(angles)))
        elif op[0] == "fixed":
            raise ValueError(f"unknown fixed tag {op[1]!r}")
        else:
            raise ValueError(f"unknown op {op[0]!r}")
    flush_rot()
    flush_u4()
    return segments


# -- execution -------------------------------------------------------------------------


def _extended(thetas: torch.Tensor) -> torch.Tensor:
    """thetas with the constant 1.0 that parameter index -1 selects."""
    return torch.cat([thetas, torch.ones(1, dtype=thetas.dtype, device=thetas.device)])


def _tile_route(seg: Segment, direction: int, n: int):
    """(layout, resident) of a segment at n qubits: the resident tile
    shape up to the chain cap, where the state sits in L2 and a span of
    tile runs is one launch, else the tile-run shape, one launch per run."""
    if n <= streaming.CHAIN_MAX_QUBITS:
        k, c = streaming.RESIDENT_TILE_BITS, streaming.RESIDENT_TILE_LOW_BITS
        return seg.tiles(direction, n, k, c), True
    return seg.tiles(direction, n, streaming.TILE_BITS, streaming.TILE_LOW_BITS), False


def rotate_segment(seg: Segment, out, arrs, n, direction: int = 1, impl=None):
    """Apply one segment's terms ``arrs = (xs, zs, angles, phre, phim)``,
    given in application order (reversed for direction -1), to ``out`` IN
    PLACE, over the spans of the segment's tile layout: a span of tile
    runs to ``impl.rotation_resident`` (up to the chain cap) or
    ``impl.rotation_runs``, terms that fit no tile to ``impl.rotation``.
    A state smaller than the smallest tile takes ``impl.rotation``."""
    impl = impl or KERNELS
    if n < TILE_MIN_BITS:
        impl.rotation(out, *arrs)
        return out
    layout, resident = _tile_route(seg, direction, n)
    tiled = impl.rotation_resident if resident else impl.rotation_runs
    for tiles, t0, t1 in layout.spans:
        part = tuple(a[t0:t1] for a in arrs)
        if tiles is not None:
            tiled(out, *part, tiles)
        else:
            impl.rotation(out, *part)
    return out


def adjoint_sweep(seg: Segment, psi, lam, arrs, n, impl=None):
    """The reverse adjoint sweep over one segment's terms ``arrs``, given
    in REVERSED order, IN PLACE on psi and lam; returns v (T,) with
    v_t = <lam | P_t psi> at the post-gate state, in reversed-term order:
    the spans of the reversed tile layout, as in :func:`rotate_segment`
    (``impl.adjoint_resident``, ``impl.adjoint_runs``, ``impl.adjoint``)."""
    impl = impl or KERNELS
    if n < TILE_MIN_BITS:
        return impl.adjoint(psi, lam, *arrs)
    layout, resident = _tile_route(seg, -1, n)
    tiled = impl.adjoint_resident if resident else impl.adjoint_runs
    parts = []
    for tiles, t0, t1 in layout.spans:
        part = tuple(a[t0:t1] for a in arrs)
        if tiles is not None:
            parts.append(tiled(psi, lam, *part, tiles))
        else:
            parts.append(impl.adjoint(psi, lam, *part))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _phase_pass(seg: Segment, out, thetas, n, direction: int):
    """A ``diag`` or ``rzlayer`` segment on ``out``, IN PLACE: exp(-i
    theta_k D) or the static RZ layer's phases, each angle times
    ``direction``."""
    rdt = real_dtype(out.dtype)
    if seg.kind == "diag":
        weights, k = seg.data
        key = (str(out.device), rdt)
        if key not in seg._cache:
            seg._cache[key] = torch.as_tensor(weights).to(device=out.device, dtype=rdt)
        theta_d = (thetas[k].to(rdt) * direction) * seg._cache[key]
        return out.mul_(torch.complex(torch.cos(theta_d), -torch.sin(theta_d)))
    key = (str(out.device), out.dtype, direction)
    if key not in seg._cache:
        phases = static_rz_layer_phases([direction * a for a in seg.data], n)
        seg._cache[key] = torch.as_tensor(phases).to(device=out.device, dtype=out.dtype)
    return out.mul_(seg._cache[key])


def _u4_pass(seg: Segment, out, n, direction: int):
    """A ``u4`` segment on ``out``: each gate one einsum over the (A, 2, B,
    2, C) view whose axes 1 and 3 are its two qubits' bits; direction -1
    applies each gate's conjugate transpose in reverse order.  Returns the
    new state."""
    key = ("u4", str(out.device), out.dtype, direction)
    if key not in seg._cache:
        d = seg.data
        U = d["U"][..., 0] + 1j * d["U"][..., 1]
        fa, fb = d["fa"], d["fb"]
        if direction == -1:
            U, fa, fb = U.conj().transpose(0, 2, 1)[::-1], fa[::-1], fb[::-1]
        gates = torch.as_tensor(np.ascontiguousarray(U).reshape(-1, 2, 2, 2, 2))
        bits = [(int(a).bit_length() - 1, int(b).bit_length() - 1) for a, b in zip(fa, fb)]
        seg._cache[key] = (gates.to(device=out.device, dtype=out.dtype), bits)
    gates, bits = seg._cache[key]
    for gate, (hi, lo) in zip(gates, bits):
        view = out.reshape(1 << (n - 1 - hi), 2, 1 << (hi - lo - 1), 2, 1 << lo)
        out = torch.einsum("xyij,aibjc->axbyc", gate, view).reshape(-1)
    return out


def run_segments(segments, psi, thetas, n, direction: int = 1, impl=None):
    """Execute the program (direction=-1: exact inverse, reversed order).

    Returns a new state; ``psi`` is left untouched.
    """
    rdt = real_dtype(psi.dtype)
    thetas_ext = _extended(thetas.to(rdt))
    out = psi.clone()
    seq = segments if direction == 1 else list(reversed(segments))
    for seg in seq:
        if seg.kind == "u4":
            out = _u4_pass(seg, out, n, direction)
            continue
        if seg.kind != "rot":
            _phase_pass(seg, out, thetas, n, direction)
            continue
        d = seg.tensors(psi.device, rdt, thetas.shape[0])
        angles = thetas_ext[d["pidx"]] * d["scale"] * direction
        arrs = (d["xb"], d["zb"], angles, d["phre"], d["phim"])
        if direction == -1:
            arrs = tuple(a.flip(0) for a in arrs)
        rotate_segment(seg, out, arrs, n, direction, impl)
    return out


def run_rot_adjoint(segment: Segment, psi_final, lam, thetas, n, impl=None):
    """Adjoint sweep over ONE rot segment: returns (psi0, lam0, grads).

    Reverse sweep: at each term (reversed), grad[pidx] += scale * Im
    <lam | P psi> evaluated at the state AFTER the gate, then both psi and
    lam are inverse-rotated.  Memory is two live statevectors.
    """
    rdt = real_dtype(psi_final.dtype)
    n_params = thetas.shape[0]
    d = segment.tensors(psi_final.device, rdt, n_params)
    angles = _extended(thetas.to(rdt))[d["pidx"]] * d["scale"]
    psi, lam = psi_final.clone(), lam.clone()
    arrs = tuple(a.flip(0) for a in (d["xb"], d["zb"], angles, d["phre"], d["phim"]))
    v = adjoint_sweep(segment, psi, lam, arrs, n, impl)
    contribs = d["scale"].flip(0) * v.imag.to(rdt)
    return psi, lam, d["fold"](contribs)


class _RotSegment(torch.autograd.Function):
    """psi = U(thetas) psi0 over one rot segment: forward on the resident or
    tile-run kernels (:func:`run_segments`), backward the adjoint sweep from
    the saved final state (:func:`run_rot_adjoint`, two live states).  For a
    real loss torch hands the backward w = 2 dL/dpsi*; it returns U^dag w
    for psi0 and scale_t Im <w_t|P_t psi_t> summed per parameter."""

    @staticmethod
    def forward(ctx, psi0, thetas, seg, n, impl):
        out = run_segments([seg], psi0, thetas, n, impl=impl)
        ctx.seg, ctx.n, ctx.impl = seg, n, impl
        ctx.save_for_backward(out, thetas)
        return out

    @staticmethod
    def backward(ctx, w):
        psi, thetas = ctx.saved_tensors
        _, lam0, grads = run_rot_adjoint(ctx.seg, psi, w.contiguous(), thetas, ctx.n, ctx.impl)
        return lam0, grads.to(thetas.dtype), None, None, None


def rot_segment(seg: Segment, psi0, thetas, n, impl=None):
    """U(thetas) psi0 for one rot segment, differentiable in psi0 and
    thetas (:class:`_RotSegment`); ``psi0`` is left untouched."""
    if seg.kind != "rot":
        raise ValueError(f"expected a rot segment, got {seg.kind!r}")
    return _RotSegment.apply(psi0, thetas, seg, n, impl or KERNELS)


class CompiledCircuit:
    """ops -> segments, applied forward or inverted."""

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
