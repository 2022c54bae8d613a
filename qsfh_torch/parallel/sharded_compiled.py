"""Rotation programs, observables and the adjoint gradient on the sharded state.

Counterpart of ``qsfh_tpu/parallel/sharded_compiled.py``.  The JAX module
lowers each generator to a ``lax.scan`` of traced z-masks and the Givens
network to u4 scans, for a constant-size XLA program.  The port has no
program to keep small; it keeps the single-card lowering instead: the
ansatz and the Givens network (``engine.compiled.givens_network_static_ops``)
are ONE rot segment of Pauli rotations, and :class:`ShardedRotations` walks
that segment on the shards through the rotation kernels.

Cross-shard rotations: the stacked pair.  The segment is cut into maximal
runs of consecutive terms whose x_hi lies in {0, m} (:func:`split_runs`).
A run with no cross term runs on the n_local-qubit shard, each term's
device sign (-1)^popcount(d & z_hi) folded into its phase.  A run with
cross terms (x_hi = m) takes ONE exchange: the rank stacks [own | partner]
as an (n_local + 1)-qubit state, on which every term of the run is a Pauli
rotation again, with

    x' = x_lo | [x_hi != 0] << n_local,
    z' = z_lo | (popcount(m & z_hi) & 1) << n_local,

and the rank's sign in the phase; the rotation kernels run on the stacked
state, and the rank keeps its own half (ranks d and d ^ m both do the pair's
work, each in its own frame).  The state lives in the first half of one
buffer of two shards (:meth:`ShardedRotations.pair_buffer`), and a pair
run receives the partner's shard straight into the second half: no copy
of the state is made a run.  The adjoint sweep does the same with psi and
lambda, each in its own pair buffer (one exchange a run for both); a pair
run's <lam|P_t psi> counts both halves, so the rank-order sum over ranks
counts each shard twice: halved, exactly.  At D = 2 every cross term has
m = 1, so the stretch from the first cross term to the last is one pair
run.  Per rank, a pair term costs the rotation of two shards: at D ranks
the program's work is (T_local + 2 T_pair) / D of one card's T terms, and
a train step holds psi's and lambda's pair buffers, four shards (at D = 2
as many bytes as one card's psi and lambda).

Observables and the pool split by x_hi: the x_hi = 0 terms act on the
shard; each m != 0 acts on the partner's shard (one exchange per distinct
m, shared by every observable of one state), with local masks and the
device sign in the coefficients: E through ``expectation_grouped`` (own)
and ``expectation_partner`` (own against partner), H psi through
``pauli_apply_grouped`` on each, the screen through ``screen_grouped`` with
w own and psi the partner.  Partial sums meet in one rank-order
:func:`comm.all_sum` a step.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..engine.compiled import (Segment, _extended, adjoint_sweep, givens_network_static_ops,
                               lower_program, rotate_segment)
from ..engine.expectation import Observable, PackedPool
from ..engine.state import real_dtype
from . import comm
from .shmap_engine import ShardedPauliEngine, _split_mask_flat, parities


def _check_mask_widths(engine: ShardedPauliEngine):
    """The stacked pair indexes n_local + 1 bits with 32-bit masks."""
    if engine.n_local + 1 > 32:
        raise ValueError(f"local shard index space {engine.n_local} bits exceeds the 32-bit "
                         "masks (shard over more ranks)")


# -- host packing (the JAX module's layouts) ------------------------------------------------


def pack_generator(engine: ShardedPauliEngine, rot_terms,
                   allow_noncommuting: bool = False) -> List[tuple]:
    """A generator's (x, z, scale) terms as CONTIGUOUS same-x runs:
    [(x_qmask, z_lo[], z_hi[], scale[], phre[], phim[])] in term order, the
    JAX module's packing.  Raises where two strings anticommute unless
    ``allow_noncommuting`` (the JAX adjoint evaluates a slot's gradient at
    the post-slot state, exact only for commuting strings; the port's
    adjoint sweeps term by term and has no such limit, but keeps the check
    for the generators it is given)."""
    _check_mask_widths(engine)
    terms = [(int(x), int(z)) for (x, z, _s) in rot_terms]
    if not allow_noncommuting:
        for i, (xa, za) in enumerate(terms):
            for xb, zb in terms[i + 1:]:
                if (bin(xa & zb).count("1") + bin(xb & za).count("1")) % 2:
                    raise ValueError(
                        f"pack_generator: strings (x={xa:#x},z={za:#x}) and (x={xb:#x},"
                        f"z={zb:#x}) anticommute. Pass allow_noncommuting=True only for "
                        "forward-only use.")
    runs: List[tuple] = []
    for (x, z, scale) in rot_terms:
        if not runs or runs[-1][0] != int(x):
            runs.append((int(x), []))
        runs[-1][1].append((int(z), float(scale)))
    out = []
    lo_mask = (1 << engine.n_local) - 1
    for x, run in runs:
        zb = [engine._flat(z) for z, _ in run]
        ph = [(-1j) ** (bin(x & z).count("1") % 4) for z, _ in run]
        out.append((x, np.asarray([b & lo_mask for b in zb], np.uint32),
                    np.asarray([b >> engine.n_local for b in zb], np.uint32),
                    np.asarray([s for _, s in run], np.float64),
                    np.asarray([p.real for p in ph], np.float64),
                    np.asarray([p.imag for p in ph], np.float64)))
    return out


def pack_terms(engine: ShardedPauliEngine, xs, zs, cs) -> List[tuple]:
    """Terms c X^x Z^z applied as c s(b) psi[b ^ x] (qubit masks, the scan
    coefficients) grouped by the device part of their flip mask:
    [(x_hi, x_lo[], z_lo[], z_hi[], cre[], cim[])] sorted by x_hi."""
    _check_mask_widths(engine)
    groups: dict = {}
    for x, z, c in zip(xs, zs, cs):
        x_hi, x_lo = _split_mask_flat(engine._flat(int(x)), engine.n, engine.k)
        z_hi, z_lo = _split_mask_flat(engine._flat(int(z)), engine.n, engine.k)
        groups.setdefault(x_hi, []).append((x_lo, z_lo, z_hi, complex(c)))
    return [(x_hi, np.asarray([t[0] for t in terms], np.uint32),
             np.asarray([t[1] for t in terms], np.uint32),
             np.asarray([t[2] for t in terms], np.uint32),
             np.asarray([t[3].real for t in terms], np.float64),
             np.asarray([t[3].imag for t in terms], np.float64))
            for x_hi, terms in sorted(groups.items())]


def pack_observable(engine: ShardedPauliEngine, op) -> List[tuple]:
    """A PauliSum grouped by the device part of its flip masks, the
    coefficients carrying the (-1)^{|x&z|} reorder sign: the JAX module's
    [(x_hi, x_lo[], z_lo[], z_hi[], cre[], cim[])]."""
    cs = [complex(c) * (-1.0) ** (bin(int(x) & int(z)).count("1") & 1)
          for x, z, c in zip(op.x, op.z, op.c)]
    return pack_terms(engine, op.x, op.z, cs)


# -- rotation runs ---------------------------------------------------------------------------


def split_runs(x_hi) -> List[tuple]:
    """The rotation runs of a term sequence with device flip bits ``x_hi``:
    [(m, t0, t1)], m = 0 for a run on the shard, else the maximal run of
    terms whose x_hi lies in {0, m} from its first cross term to its last
    (its leading and trailing x_hi = 0 terms run on the shard)."""
    x_hi = [int(v) for v in x_hi]
    runs, t, T = [], 0, len(x_hi)
    while t < T:
        if x_hi[t] == 0:
            t1 = t
            while t1 < T and x_hi[t1] == 0:
                t1 += 1
            runs.append((0, t, t1))
            t = t1
            continue
        m, last, t1 = x_hi[t], t, t
        while t1 < T and x_hi[t1] in (0, m):
            if x_hi[t1] == m:
                last = t1
            t1 += 1
        runs.append((m, t, last + 1))
        t = last + 1
    return runs


def stacked_masks(x_lo, x_hi, z_lo, z_hi, m: int, n_local: int):
    """The flat masks of terms with x_hi in {0, m} on the stacked pair
    [own | partner] of n_local + 1 qubits."""
    top = np.int64(1) << n_local
    xs = np.asarray(x_lo, np.int64) | np.where(np.asarray(x_hi) != 0, top, 0)
    zs = np.asarray(z_lo, np.int64) | parities(np.asarray(z_hi, np.int64) & m) * top
    return xs, zs


class ShardedRotations:
    """A rot program (ops as ``engine.compiled.CompiledCircuit`` takes them,
    lowering to one rot segment) on the sharded state, cut into rotation
    runs (:func:`split_runs`): ``pieces`` is [(m, Segment)] with the run's
    local masks (m = 0) or its stacked-pair masks (m != 0), the rank's
    device signs in the phases.  ``global_phase`` multiplies the state
    after the forward program (the Givens network's)."""

    def __init__(self, engine: ShardedPauliEngine, ops, global_phase: complex = 1.0):
        self.engine = engine
        self.global_phase = complex(global_phase)
        segs = lower_program(ops, engine.n) if ops else []
        if len(segs) > 1 or any(s.kind != "rot" for s in segs):
            raise ValueError("ShardedRotations takes programs of rot ops (one rot segment)")
        self.full = segs[0] if segs else None
        self.pieces: List[tuple] = []
        if self.full is None:
            return
        _check_mask_widths(engine)
        d, nl = self.full.data, engine.n_local
        lo = (1 << nl) - 1
        xb, zb = d["xb"].astype(np.int64), d["zb"].astype(np.int64)
        x_hi, x_lo, z_hi, z_lo = xb >> nl, xb & lo, zb >> nl, zb & lo
        sign = engine.device_signs(z_hi)
        for m, t0, t1 in split_runs(x_hi):
            s = slice(t0, t1)
            xs, zs = x_lo[s], z_lo[s]
            if m:
                xs, zs = stacked_masks(xs, x_hi[s], zs, z_hi[s], m, nl)
            self.pieces.append((m, Segment("rot", dict(
                xb=xs.astype(np.uint32), zb=zs.astype(np.uint32), scale=d["scale"][s],
                pidx=d["pidx"][s], phre=d["phre"][s] * sign[s], phim=d["phim"][s] * sign[s]))))

    @property
    def exchanges(self) -> int:
        """Exchanges of one forward or inverse pass (and of an adjoint
        sweep, psi and lambda together)."""
        return sum(1 for m, _ in self.pieces if m)

    def pair_buffer(self, psi_l):
        """A new buffer of two shards (one where the program has no pair
        run), ``psi_l`` copied into its first half: the stacked pair [own |
        partner], whose second half a pair run receives the partner's shard
        into."""
        half = psi_l.shape[0]
        buf = psi_l.new_empty(((2 if self.exchanges else 1) * half,))
        buf[:half].copy_(psi_l)
        return buf

    def _arrays(self, seg, thetas, ext, direction):
        t = seg.tensors(ext.device, ext.dtype, thetas.shape[0])
        arrs = (t["xb"], t["zb"], ext[t["pidx"]] * t["scale"] * direction, t["phre"], t["phim"])
        return arrs if direction == 1 else tuple(a.flip(0) for a in arrs)

    def run(self, buf, thetas, direction: int = 1, impl=None):
        """The program (direction -1: its exact inverse) IN PLACE on the
        shard in the first half of a :meth:`pair_buffer`; returns that half."""
        impl = impl or self.engine.impl
        nl = self.engine.n_local
        half = 1 << nl
        own = buf[:half]
        ext = _extended(thetas.to(real_dtype(buf.dtype)))
        for m, seg in (self.pieces if direction == 1 else self.pieces[::-1]):
            arrs = self._arrays(seg, thetas, ext, direction)
            if m == 0:
                rotate_segment(seg, own, arrs, nl, direction, impl)
                continue
            self.engine.exchange_into([own], [buf[half:]], m)
            rotate_segment(seg, buf, arrs, nl + 1, direction, impl)
        phase = self.global_phase if direction == 1 else self.global_phase.conjugate()
        return own if phase == 1 else own.mul_(phase)

    def apply(self, psi_l, thetas, direction: int = 1, impl=None):
        """The program (direction -1: its exact inverse) on the shard; a new
        tensor of one shard, ``psi_l`` left untouched."""
        own = self.run(self.pair_buffer(psi_l), thetas, direction, impl)
        return own.clone() if self.exchanges else own

    def sweep(self, psi_buf, lam_buf, thetas, impl=None):
        """This rank's share of the gradient, (n_params,) real: per
        parameter sum_t scale_t Im <lam|P_t psi> over the post-gate states
        of a reverse sweep from psi and lam at the end of the program, held
        in the first halves of two :meth:`pair_buffer` (both are used up:
        the sweep runs IN PLACE on them); the gradient is
        :func:`comm.all_sum` of the ranks' shares."""
        impl = impl or self.engine.impl
        rdt = real_dtype(psi_buf.dtype)
        n_params = thetas.shape[0]
        if self.full is None:
            return torch.zeros(n_params, dtype=rdt, device=psi_buf.device)
        nl = self.engine.n_local
        half = 1 << nl
        ext = _extended(thetas.to(rdt))
        parts = []
        for m, seg in self.pieces[::-1]:
            t = seg.tensors(psi_buf.device, rdt, n_params)
            arrs = tuple(a.flip(0) for a in (t["xb"], t["zb"], ext[t["pidx"]] * t["scale"],
                                             t["phre"], t["phim"]))
            if m == 0:
                parts.append(adjoint_sweep(seg, psi_buf[:half], lam_buf[:half], arrs, nl, impl))
                continue
            self.engine.exchange_into([psi_buf[:half], lam_buf[:half]],
                                      [psi_buf[half:], lam_buf[half:]], m)
            parts.append(0.5 * adjoint_sweep(seg, psi_buf, lam_buf, arrs, nl + 1, impl))
        full = self.full.tensors(psi_buf.device, rdt, n_params)
        v = torch.cat(parts)
        return full["fold"](full["scale"].flip(0) * v.imag.to(rdt))

    def adjoint_partials(self, psi_l, lam_l, thetas, impl=None):
        """:meth:`sweep` from copies of psi_l and lam_l (left untouched)."""
        return self.sweep(self.pair_buffer(psi_l), self.pair_buffer(lam_l), thetas, impl)

    def adjoint(self, psi_l, lam_l, thetas, impl=None):
        """The gradient (the same bits on every rank)."""
        return comm.all_sum(self.adjoint_partials(psi_l, lam_l, thetas, impl))


def generator_rotation(engine: ShardedPauliEngine, psi_l, packed, theta, inverse: bool = False):
    """exp(-i theta G)|psi> (inverse: its exact inverse) for a generator
    packed by :func:`pack_generator`."""
    prog = ShardedRotations(engine, [("rot", tuple(_unpacked(engine, packed)), 0)])
    th = torch.as_tensor([float(theta)], dtype=real_dtype(psi_l.dtype), device=psi_l.device)
    return prog.apply(psi_l, th, direction=-1 if inverse else 1)


def apply_generator(engine: ShardedPauliEngine, psi_l, packed):
    """G|psi> for a generator packed by :func:`pack_generator`."""
    return engine.apply_generator(psi_l, _unpacked(engine, packed))


def _unpacked(engine: ShardedPauliEngine, packed):
    """The (x, z, scale) terms of a :func:`pack_generator` packing."""
    out = []
    for x, z_lo, z_hi, scales, _pr, _pi in packed:
        for zl, zh, s in zip(z_lo, z_hi, scales):
            flat = (int(zh) << engine.n_local) | int(zl)
            z = sum(1 << q for q in range(engine.n) if (flat >> (engine.n - 1 - q)) & 1)
            out.append((int(x), z, float(s)))
    return out


# -- observables and the pool ----------------------------------------------------------------


class ShardedObservable:
    """A Pauli sum on the sharded state: ``parts`` {x_hi: Observable} of the
    local masks, the device sign folded into each rank's coefficients;
    ``cross`` the nonzero x_hi (one exchange each)."""

    def __init__(self, engine: ShardedPauliEngine, packed):
        self.engine = engine
        self.parts = {}
        for (x_hi, x_lo, z_lo, z_hi, cre, cim) in packed:
            s = engine.device_signs(z_hi)
            self.parts[int(x_hi)] = Observable.from_scan_terms(x_lo, z_lo, cre * s, cim * s,
                                                               engine.n_local)
        self.cross = tuple(m for m in self.parts if m)

    @classmethod
    def of(cls, engine: ShardedPauliEngine, op) -> "ShardedObservable":
        return cls(engine, pack_observable(engine, op))

    def _partners(self, psi_l, partners):
        return partners if partners is not None else self.engine.partners(psi_l, self.cross)

    def partial(self, psi_l, partners=None, impl=None):
        """This rank's share of Re<psi|op|psi> (0-d real)."""
        impl = impl or self.engine.impl
        partners = self._partners(psi_l, partners)
        total = torch.zeros((), dtype=real_dtype(psi_l.dtype), device=psi_l.device)
        for m, part in self.parts.items():
            if m == 0:
                total = total + part.expectation_scan(psi_l, impl)
            else:
                total = total + part.expectation_partner_scan(psi_l, partners[m], impl)
        return total

    def expectation(self, psi_l, partners=None, impl=None):
        """Re<psi|op|psi> (the same bits on every rank)."""
        return comm.all_sum(self.partial(psi_l, partners, impl))

    def apply(self, psi_l, partners=None, impl=None, out=None):
        """This rank's shard of op|psi> (written into ``out`` where given)."""
        impl = impl or self.engine.impl
        partners = self._partners(psi_l, partners)
        out = torch.zeros_like(psi_l) if out is None else out.zero_()
        for m, part in self.parts.items():
            out.add_(part.apply_scan(psi_l if m == 0 else partners[m], impl))
        return out


def expectation_local(engine: ShardedPauliEngine, psi_l, packed_obs, impl=None):
    """Re<psi|op|psi> over a :func:`pack_observable` packing (the same bits
    on every rank)."""
    return ShardedObservable(engine, packed_obs).expectation(psi_l, impl=impl)


class ShardedPool:
    """A ``PackedPool`` on the sharded state: its flat terms split by x_hi
    into local pools (``PackedPool.from_scan_arrays``), the device sign in
    each rank's coefficients."""

    def __init__(self, engine: ShardedPauliEngine, pool: PackedPool):
        _check_mask_widths(engine)
        self.engine = engine
        xs, zs, cre, cim, ks = pool.scan_arrays()
        nl, lo = engine.n_local, (1 << engine.n_local) - 1
        xb, zb = xs.astype(np.int64), zs.astype(np.int64)
        x_hi = xb >> nl
        sign = engine.device_signs(zb >> nl)
        self.parts = {}
        for m in sorted(set(int(v) for v in x_hi)):
            sel = x_hi == m
            self.parts[m] = PackedPool.from_scan_arrays(
                xb[sel] & lo, zb[sel] & lo, cre[sel] * sign[sel], cim[sel] * sign[sel], ks[sel],
                pool.size, nl)
        self.cross = tuple(m for m in self.parts if m)
        self.size = pool.size

    def screen(self, psi_l, w_l, partners=None, impl=None):
        """grad_k = 2 Im <w | G_k psi> for every generator (the same bits on
        every rank)."""
        impl = impl or self.engine.impl
        if partners is None:
            partners = self.engine.partners(psi_l, self.cross)
        total = torch.zeros(self.size, dtype=real_dtype(psi_l.dtype), device=psi_l.device)
        for m, part in self.parts.items():
            total = total + part.screen_scan(psi_l if m == 0 else partners[m], w_l, impl)
        return comm.all_sum(total)


class ShardedMetrics:
    """The step's (Sz, S^2, fidelity) on the sharded state: shares summed
    with the step's other shares in one rank-order sum.  ``gs``: the exact
    ground states (full states; each rank keeps its shard); fidelity is the
    projection onto their span.  ``metrics=False`` reports Sz = S^2 = 0."""

    def __init__(self, engine: ShardedPauliEngine, sz_op, s2_op, gs=(), metrics: bool = True):
        from .mesh import shard_statevector

        self.engine = engine
        self.obs = ((ShardedObservable.of(engine, sz_op), ShardedObservable.of(engine, s2_op))
                    if metrics else ())
        self.cross = tuple(sorted({m for o in self.obs for m in o.cross}))
        self.gs = [shard_statevector(torch.as_tensor(g), engine.mesh) for g in gs]

    def partials(self, psi_l, partners=None, impl=None):
        """[Sz, S^2, Re <g_i|psi>, Im <g_i|psi> ...] shares (real)."""
        rdt = real_dtype(psi_l.dtype)
        vals = [o.partial(psi_l, partners, impl).reshape(1) for o in self.obs]
        if not self.obs:
            vals = [torch.zeros(2, dtype=rdt, device=psi_l.device)]
        for g in self.gs:
            ov = torch.vdot(g.to(psi_l.dtype), psi_l)
            vals.append(torch.stack([ov.real, ov.imag]).to(rdt))
        return torch.cat(vals)

    def finish(self, total):
        """(Sz, S^2, fidelity) from the summed shares."""
        ov = total[2:]
        return total[0], total[1], (ov * ov).sum()


def sharded_metrics_fn(engine: ShardedPauliEngine, sz_op, s2_op, gs=(), metrics: bool = True):
    """The (Sz, S^2, fidelity) shares of the sharded train steps, the
    JAX module's extras (:class:`ShardedMetrics`)."""
    return ShardedMetrics(engine, sz_op, s2_op, gs, metrics)


def adjoint_energy_grads(engine: ShardedPauliEngine, program: ShardedRotations, thetas, psi0,
                         observable: ShardedObservable, extras: ShardedMetrics = None,
                         impl=None):
    """Energy, gradients and extras of one train step: the forward program
    from psi0, lambda = 2 H psi, the reverse adjoint sweep, the extras on
    the final state; every share (E, the gradient, the extras) summed in ONE
    rank-order :func:`comm.all_sum`.  Exchanges: the program's runs forward
    and in the sweep, and one per distinct cross x_hi of the observables.
    psi and lambda live in the program's pair buffers, which the sweep uses
    up; the first partner's shard lands in psi's idle second half, and the
    others are let go before the sweep.
    Returns (energy, grads, extras tuple or ())."""
    psi_buf = program.pair_buffer(psi0)
    psi = program.run(psi_buf, thetas, impl=impl)
    cross = set(observable.cross) | set(extras.cross if extras is not None else ())
    spare = psi_buf[psi.shape[0]:] if program.exchanges else None
    partners = engine.partners(psi, cross, spare)
    energy = observable.partial(psi, partners, impl).reshape(1)
    rest = [extras.partials(psi, partners, impl)] if extras is not None else []
    lam_buf = torch.empty_like(psi_buf)
    observable.apply(psi, partners, impl, out=lam_buf[:psi.shape[0]]).mul_(2.0)
    del partners, psi
    grads = program.sweep(psi_buf, lam_buf, thetas, impl)
    total = comm.all_sum(torch.cat([energy, grads] + rest))
    n_params = thetas.shape[0]
    rest = extras.finish(total[1 + n_params:]) if extras is not None else ()
    return total[0], total[1:1 + n_params], rest


class ShardedGivensNetwork:
    """The Slater/FT Givens network on the sharded state, as its static Pauli
    rotations (``givens_network_static_ops``, the single-card port's form)
    through :class:`ShardedRotations`, with its global phase."""

    def __init__(self, engine: ShardedPauliEngine, diagonal, decomposition):
        ops, phase = givens_network_static_ops(engine.n, diagonal, decomposition)
        self.program = ShardedRotations(engine, ops, phase)
        self._empty = {}

    def apply(self, psi_l, inverse: bool = False, impl=None):
        key = (str(psi_l.device), psi_l.dtype)
        if key not in self._empty:
            self._empty[key] = torch.zeros(0, dtype=real_dtype(psi_l.dtype), device=psi_l.device)
        return self.program.apply(psi_l, self._empty[key], -1 if inverse else 1, impl)
